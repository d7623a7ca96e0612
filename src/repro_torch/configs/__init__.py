"""Architecture configs of the port and the input shapes
(:mod:`repro_torch.configs.base`); see :mod:`repro_torch.configs.registry`."""
