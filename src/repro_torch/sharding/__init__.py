"""The sharding planner and the activation constraints (JAX package:
``sharding/``)."""
