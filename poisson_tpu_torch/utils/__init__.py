"""Device resolution and timing."""
