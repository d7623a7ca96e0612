"""Architecture configs of the port (the dense-GQA models); see
:mod:`repro_torch.configs.registry`."""
