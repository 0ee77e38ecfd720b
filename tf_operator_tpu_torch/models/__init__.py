"""The port's model code: the llama decoder, its caches and the paged
serving pool, and ResNet."""
