"""The benchmark's own code: finding files by name, the traffic generator,
the serving and training loops, the device trace's reduction, the work
counts and the check that decides ``correct``."""
