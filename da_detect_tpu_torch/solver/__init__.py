"""Detectron SGD and the learning-rate schedules."""
