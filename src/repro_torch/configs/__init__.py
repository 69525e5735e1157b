"""Architecture configurations (`base.ArchConfig` and its family configs)."""
