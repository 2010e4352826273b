"""Loss heads: RadZeroLoss (VL-CABS + MP-NCE) and the CLIP / SigLIP auxiliaries."""
