"""Entry points of the port: ``serve`` (``serve.serve_decode``) and
``train``."""
