"""Architecture configs: the port's own copy of ``repro.configs`` (same
dataclasses, same values), so that ``repro_torch`` imports nothing from
``repro``."""
