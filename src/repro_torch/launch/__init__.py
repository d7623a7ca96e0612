"""Entry points of the port: the federated LM trainer
(``python -m repro_torch.launch.train``)."""
