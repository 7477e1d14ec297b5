"""Models of the port: the transformer's dense GQA serving path."""
