"""MIMIC-CXR and MS-CXR preprocessing (port of radzero_tpu/preprocess/):
host code only, which launches no kernel."""
