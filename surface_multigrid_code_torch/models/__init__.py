"""Application models: the elastic shell and the balloon simulation."""
