"""Support code that only the port's tests run."""
