"""The benchmark's plain reference: the models, the federated rounds and
the uplink compressor in plain PyTorch, written from the paper and the
published architectures.  It imports nothing of the program under test,
takes the inputs the harness makes, and works out again whatever the
program derives from them (the batches a supplier samples included)."""
