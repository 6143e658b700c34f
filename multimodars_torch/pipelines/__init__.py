"""Domain pipelines (the reference's L3): intra-/inter-pullback alignment,
postprocessing, wall synthesis, centerline registration and entry
orchestration."""
