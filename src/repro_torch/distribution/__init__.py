"""Distribution: sharding rules and logical annotations (DTensor)."""
