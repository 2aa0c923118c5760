"""Whole-frame device pipelines over uniform tiles (torch port of
thor_tpu/models)."""
