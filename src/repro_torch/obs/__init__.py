"""Port of ``repro/obs``: tracing spans and the metrics registry
(framework-free copies; the logging setup is not ported yet)."""
