"""One module a model family: the benchmark's weights for it, the
program's gradient function built from a configuration file, the batches
its traffic feeds, and its operation counts.  ``pb.bench`` loads the module
the configuration's ``family`` names."""
