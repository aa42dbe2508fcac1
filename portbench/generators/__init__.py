"""The benchmark's traffic generators: one general generator for each
traffic kind, driven by a data file under `portbench/traffic/`."""
