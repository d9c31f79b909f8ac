"""Core math and hashing shared by the port's subsystems."""
