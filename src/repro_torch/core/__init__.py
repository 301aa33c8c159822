"""The paper's core objects: Hadamard preconditioning, structured
Gaussian matrices, spinner pipelines, feature maps and SRF attention."""
