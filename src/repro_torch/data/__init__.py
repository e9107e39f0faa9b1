"""Application data for the port: the UNOMT data-engineering pipeline
(``unomt``) and the step-addressable synthetic LM batches
(``synthetic``)."""
