"""Synthetic federated datasets (numpy)."""
