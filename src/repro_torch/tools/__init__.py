"""Command-line tools of the port, run as ``python -m
repro_torch.tools.<name>``: ``trace_summary`` (the stage table of a
JSON-lines trace, and diffs of two) and ``check_api_surface`` (the pinned
``__all__`` lists)."""
