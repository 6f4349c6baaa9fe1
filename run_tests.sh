#!/bin/bash
# CPU test runner: JAX on the CPU backend; conftest.py adds 8 virtual devices.
exec env JAX_PLATFORMS=cpu python -m pytest "${@:-tests/ -q}"
