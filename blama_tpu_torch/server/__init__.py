"""Serving: the solo server, the continuous-batching scheduler and HTTP."""
