"""The federated simulator and the paper's problem set-ups."""
