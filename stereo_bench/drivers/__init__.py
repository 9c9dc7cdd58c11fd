"""Traffic kinds: one module each, ``run(ctx) -> record`` and
``unit_flops(cell, config, ref)`` (``ref`` the configuration's model
reference), found by a cell's ``driver``."""
