"""Step functions of the port (serving: ``steps.make_serve_step``)."""
