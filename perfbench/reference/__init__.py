"""Plain references, one module per kind of configuration; a
configuration's file names its module under ``reference``."""
