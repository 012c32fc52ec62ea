"""The general machinery of the benchmark: cell lookup, seeded inputs,
arrival schedules, tracing and the correctness comparison.  Everything
particular to one configuration, traffic mix or metric lives in a file of
its own under ``bench/``."""
