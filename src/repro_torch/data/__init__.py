"""Application data for the port: the UNOMT data-engineering pipeline
(``unomt``), the step-addressable synthetic LM batches
(``synthetic``) and the dictionary encoding of string columns
(``dictionary``)."""
