"""Train steps (``steps``), JSONL metrics and the device clock
(``metrics``), held-out eval (``evaluate``), serving (``serve``) and the
legacy flat driver (``train``, a shim over ``repro_torch.api``). The JAX
package's dry run for a TPU pod has no twin (``ROADMAP.md``, A11)."""
