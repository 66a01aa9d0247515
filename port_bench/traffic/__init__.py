"""Traffic loops, one module per generator (``<generator>.py``), each driven by
the parameters of a traffic mix (``<traffic>.json``)."""
