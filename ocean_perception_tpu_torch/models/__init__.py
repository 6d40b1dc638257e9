"""The perception step."""
