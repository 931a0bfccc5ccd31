"""Application shell: the batch CLI (`cli`) and the viewer server
(`serve`)."""
