"""repro_torch.analysis — the runtime plan validator
(``plan_validator.validate_plan``).  The static checker stays in the JAX
package and scans this package's sources too."""
