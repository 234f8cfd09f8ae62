"""Multi-device layout of the port: collectives over a DeviceMesh's named dims, and the fleet rules."""
