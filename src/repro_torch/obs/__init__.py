"""Port of ``repro/obs``: tracing spans, the metrics registry and the
launchers' logging setup (framework-free copies)."""
