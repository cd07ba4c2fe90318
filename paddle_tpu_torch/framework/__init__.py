"""Device resolution and seeded generators."""
