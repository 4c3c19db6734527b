"""The plain reference (numpy and scipy, float64) and the comparison that decides ``correct``."""
