"""Model / Instance / Session runtime, sampler and verification."""
