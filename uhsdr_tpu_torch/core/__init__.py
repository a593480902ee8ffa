"""Block streaming over a chain step."""
