"""Run analysis: the ``--profile N`` profiler window (devprof)."""
