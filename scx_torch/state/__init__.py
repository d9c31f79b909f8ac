"""Entity state of the port (scx.state): struct-of-arrays columns with a leading env axis."""
