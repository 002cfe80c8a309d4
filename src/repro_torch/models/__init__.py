"""Model pieces of the port that the tiered-KV serving engine calls."""
