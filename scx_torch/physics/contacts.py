"""Contact constants shared with scx.physics.contacts."""

MAX_CONTACTS_PER_PAIR = 4
