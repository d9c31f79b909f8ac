"""Applications of the port (scx.app): the sim tick and the RL fleet env."""
