"""Observability: the span/event tracer (``trace``)."""
