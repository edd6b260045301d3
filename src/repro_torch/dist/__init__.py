"""Distribution: the sharding rule engine (``sharding``) and the activation
policy (``ctx``), ports of ``repro/dist``.  Nothing here touches a device or
a process group when imported."""
from . import ctx, sharding  # noqa: F401
