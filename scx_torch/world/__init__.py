"""World content of the port (scx.world): procedural sectors and culling."""
