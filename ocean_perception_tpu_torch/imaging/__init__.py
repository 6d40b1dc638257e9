"""Sea-thru underwater image enhancement."""
