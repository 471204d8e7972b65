"""Entry points of the port: the training and serving drivers, the dry
run, and the card's hardware table (``mesh.HW``)."""
