"""MILO core on PyTorch: similarity, set functions, greedy engines,
exploration, curriculum, artifacts and the preprocessing orchestrator.

Modules are imported directly (``repro_torch.core.milo`` and so on); this
package file imports nothing so that the numpy-only modules stay light.
"""
