"""The benchmark harness: finds a cell's configuration, traffic and metric
readers by the names in ``BENCHMARK.json``, builds the program under test
from them, times it and decides ``correct`` against ``reference``."""
