"""Model configs, weight loading and forward passes."""
