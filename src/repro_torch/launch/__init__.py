"""Entry points of the port (``serve.serve_decode``)."""
