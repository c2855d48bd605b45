"""Step factories of the port (serving only: training comes later)."""
