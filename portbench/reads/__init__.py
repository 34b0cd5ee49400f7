"""Lens read kinds, one module a name: a traffic mix's ``reads.kinds``
names each with its share of the reads. A kind's module issues the read
through the store's API, brings the answer to the generator's ids, works
out the reference's answer in the same form, and measures their gap under
the check it names."""
