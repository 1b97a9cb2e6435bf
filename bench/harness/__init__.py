"""The general parts of the benchmark: the spec loader, the seeded weights,
the traffic generator, the serve and train runners, the profiler reduction
and the result line."""
