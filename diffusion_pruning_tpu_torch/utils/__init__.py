"""Device selection and random initialisation."""
