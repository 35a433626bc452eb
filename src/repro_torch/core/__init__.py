"""Platform models the port needs (copy of parts of ``repro.core``)."""
