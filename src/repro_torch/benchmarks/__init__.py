"""The port's benchmark tables: each a declarative ``SuiteSpec`` run
through ``run_suite``."""
