"""Training of the port: optimizer, gradient compression, train step."""
