"""Analyses that run before a shuffle: :mod:`.planner`, the plan
compiler. Nothing here is imported unless ``RSDL_PLAN`` asks for it."""
