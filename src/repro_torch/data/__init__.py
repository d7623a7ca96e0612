"""Synthetic federated datasets (numpy): the logistic generator of Fig. 2-3
and the procedural MNIST-like images of Fig. 4."""
