"""Traffic of the port (scx.traffic): lane graph, LOD and the scripted AI."""
