"""Application data for the port: the UNOMT data-engineering pipeline
(``unomt``)."""
