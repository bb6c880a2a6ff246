"""The port's API layer: so far the metrics registry (``metrics``) and
the metric catalog (``metrics_defs``) the rest of the port instruments
against."""
