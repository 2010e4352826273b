"""The similarity-map visualization suite (port of radzero_tpu/viz/): maps
from the scorer on the card, rendered with numpy and PIL."""

from radzero_torch.viz.overlays import (
    extract_similarity_map,
    overlay_heatmap,
    render_attention_panel,
)
from radzero_torch.viz.qualitative import (
    filter_top_k_percent,
    process_and_visualize_map,
    process_and_visualize_segmentation,
    visualize_disease_segmap,
    visualize_segmap,
)
