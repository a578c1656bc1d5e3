"""The LM stack of the port: the dense decoder (``layers``,
``transformer``), the family API and the parameter converter."""
