"""Step functions of the port (``steps``: the train and serve steps) and
the training loop's ``monitor.StragglerMonitor``."""
