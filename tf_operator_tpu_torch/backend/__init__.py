"""The part of ``tf_operator_tpu/backend`` the port's serving plane needs."""
