from scx_torch.telemetry.snapshots import FrameTelemetry, TelemetryHub
