"""One module per kind of request loop, found by the ``kind`` a workload file names."""
