"""Dense attention models of the port (``layers``, ``lm``)."""
