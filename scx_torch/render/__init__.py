"""The render path of the port (scx.render)."""
