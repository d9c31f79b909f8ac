"""Host-side asset helpers of the port (scx.assets), numpy only."""
