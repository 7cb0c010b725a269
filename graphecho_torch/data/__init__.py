"""Data of the port (numpy, NHWC batch dicts): the on-disk dataset readers,
the threaded loader and the synthetic batches."""
