"""Entry points of the port: the federated LM trainer
(``python -m repro_torch.launch.train``), the multi-pod dry run
(``python -m repro_torch.launch.dryrun``), and the meshes and sharding
rules they place on (``mesh``, ``sharding``)."""
