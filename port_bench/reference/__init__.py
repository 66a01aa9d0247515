"""Plain fp32 references, one module per configuration; they import nothing of the port."""
