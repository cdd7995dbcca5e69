"""Operation and byte counts from shapes: one module per objective or
kernel, named in the configurations and the readers."""
