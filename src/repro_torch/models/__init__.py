"""The model stack: configurations, parameter specs, layers, attention and
the dense decoder, written against the stacked rank axis of ``dist``."""
