"""How the port is built and driven for each configuration, one module per configuration."""
