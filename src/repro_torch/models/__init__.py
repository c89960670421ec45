"""The transformer zoo's decode path (``layers``, ``transformer``)."""
