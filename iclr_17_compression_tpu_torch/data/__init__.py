"""Training and eval data, numpy only."""
