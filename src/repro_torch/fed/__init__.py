"""The federated simulator, the paper's problem set-ups and the
multi-process runtime (:mod:`repro_torch.fed.runtime`)."""
