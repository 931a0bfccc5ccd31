"""The deployment layouts the drivers build on, one module each, named by
a configuration's `layout.kind`."""
