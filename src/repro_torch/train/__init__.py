"""Training substrate of the port: the optimizer and the train step."""
