"""The roofline of the port: the wire term of the multi-process runtime and
the model-FLOP yardstick (:mod:`repro_torch.roofline.analysis`)."""
