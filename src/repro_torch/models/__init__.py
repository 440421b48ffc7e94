"""Model families of the port (dense in this slice)."""
