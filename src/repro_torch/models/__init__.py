"""Model code of the port: dense GQA decode (``repro/models``)."""
