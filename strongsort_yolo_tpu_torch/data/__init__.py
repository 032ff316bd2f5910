"""MOTChallenge-format sequences and the tracking evaluation harness."""
