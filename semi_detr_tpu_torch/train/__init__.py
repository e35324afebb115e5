"""Training: optimizer, state and EMA, schedules, the supervised step."""
