"""Tree checkpoints in the reference's npz layout (:mod:`repro_torch.checkpoint.ckpt`)."""
